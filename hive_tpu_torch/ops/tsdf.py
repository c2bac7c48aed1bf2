"""Dense TSDF voxel-volume fusion and frustum-bound estimation.

Counterpart of ``hive_tpu/ops/tsdf.py``: the dense ``TSDFVolume`` (every
voxel projects into every frame; the oracle the sparse integrator is held
to, and the ``tsdf_fusion(use_sparse=False)`` backend) and the host-side
``estimate_volume_bounds`` / ``estimate_volume_bounds_from_max_depths``.
Poses passed to ``integrate`` are camera-to-world matrices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device


class TSDFState(NamedTuple):
    """The voxel grid: (X, Y, Z) tsdf/weight and (3, X, Y, Z) colour planes."""

    tsdf: torch.Tensor    # truncated signed distance, in [-1, 1], init 1
    weight: torch.Tensor  # accumulated observation weight, init 0
    color: torch.Tensor   # (3, X, Y, Z) running-mean RGB in [0, 255]


class TSDFVolume:
    """A dense truncated signed distance volume.

    Constructed from (3, 2) volume bounds + voxel size;
    ``integrate_frames`` fuses a frame stack, ``get_mesh`` extracts.
    """

    def __init__(self, volume_bounds, voxel_size: float, trunc_margin: Optional[float] = None,
                 use_color: bool = True, dtype=torch.float32, device=None):
        """
        :param dtype: Storage dtype (``torch.bfloat16`` halves memory);
            updates accumulate in float32.
        :param device: ``"cpu"`` or a CUDA device; default ``cuda:0``.
        """
        volume_bounds = np.asarray(volume_bounds, dtype=np.float32)

        if volume_bounds.shape != (3, 2):
            raise ValueError(f"volume_bounds must be (3, 2), got {volume_bounds.shape}")

        self.device = get_device(device)
        self.voxel_size = float(voxel_size)
        self.trunc_margin = float(trunc_margin if trunc_margin is not None
                                  else 5.0 * voxel_size)

        dims = np.ceil((volume_bounds[:, 1] - volume_bounds[:, 0]) / voxel_size).astype(int)
        self.dims: Tuple[int, int, int] = tuple(int(d) for d in np.maximum(dims, 1))
        self.origin = volume_bounds[:, 0].copy()
        self.volume_bounds = volume_bounds

        X, Y, Z = self.dims
        dev = self.device
        self.state = TSDFState(
            tsdf=torch.ones((X, Y, Z), dtype=dtype, device=dev),
            weight=torch.zeros((X, Y, Z), dtype=dtype, device=dev),
            color=torch.zeros((3, X, Y, Z), dtype=dtype, device=dev),
        )
        self._use_color = use_color

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.dims))

    # -- integration ---------------------------------------------------------
    def integrate(self, color_image, depth_image, camera_matrix, cam_to_world_pose,
                  obs_weight: float = 1.0):
        """Fuse a single RGB-D frame."""
        self.integrate_frames(
            colors=np.asarray(color_image, dtype=np.float32)[None],
            depths=np.asarray(depth_image, dtype=np.float32)[None],
            camera_matrix=camera_matrix,
            cam_to_world_poses=np.asarray(cam_to_world_pose, dtype=np.float32)[None],
            obs_weights=np.asarray([obs_weight], dtype=np.float32),
        )

    def integrate_frames(self, colors, depths, camera_matrix, cam_to_world_poses,
                         obs_weights=None):
        """Fuse a stack of frames, one frame at a time.

        :param colors: (N, H, W, 3) RGB (uint8 or float).
        :param depths: (N, H, W) float32 meters (0 = invalid).
        :param camera_matrix: (3, 3) shared intrinsics.
        :param cam_to_world_poses: (N, 4, 4) camera-to-world transforms.
        :param obs_weights: optional (N,) per-frame weights (default 1).
        """
        dev = self.device
        depths = torch.as_tensor(depths, device=dev).to(torch.float32)
        colors = torch.as_tensor(colors, device=dev)
        n = depths.shape[0]
        if obs_weights is None:
            obs_weights = np.ones((n,), np.float32)
        obs_weights = torch.as_tensor(np.asarray(obs_weights, np.float32), device=dev)

        K = np.asarray(camera_matrix, dtype=np.float32)
        intr = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=dev)
        world_to_cams = torch.as_tensor(world_to_camera(cam_to_world_poses), device=dev)
        origin = torch.as_tensor(self.origin, device=dev)

        for f in range(n):
            self._integrate_one(depths[f], colors[f].to(torch.float32),
                                world_to_cams[f], obs_weights[f], intr, origin)
        return self

    def _integrate_one(self, depth, color_im, world_to_cam, obs_weight, intr, origin):
        """Fuse one frame into the state (in place: the volume is the run's
        largest allocation)."""
        X, Y, Z = self.dims
        height, width = depth.shape
        dev = self.device
        R = world_to_cam[:3, :3]
        t = world_to_cam[:3, 3]

        ix = torch.arange(X, dtype=torch.float32, device=dev)[:, None, None]
        iy = torch.arange(Y, dtype=torch.float32, device=dev)[None, :, None]
        iz = torch.arange(Z, dtype=torch.float32, device=dev)[None, None, :]

        base = R @ origin + t
        step = R * float(np.float32(self.voxel_size))

        # XLA:CPU contracts the affine map into an FMA chain from the base,
        # and the running means below into one FMA each; torch.addcmul is
        # one FMA on the CPU and on the card.
        def camera(axis):
            coords = torch.addcmul(base[axis].expand(X, 1, 1), ix, step[axis, 0])
            return torch.addcmul(torch.addcmul(coords, iy, step[axis, 1]), iz, step[axis, 2])

        cam_x, cam_y, cam_z = camera(0), camera(1), camera(2)

        fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
        safe_z = torch.where(cam_z > 1e-6, cam_z, 1.0)
        u = torch.round(fx * cam_x / safe_z + cx).to(torch.int32)
        v = torch.round(fy * cam_y / safe_z + cy).to(torch.int32)
        in_view = (cam_z > 1e-6) & (u >= 0) & (u < width) & (v >= 0) & (v < height)

        flat_idx = (torch.clamp(v, 0, height - 1).long() * width
                    + torch.clamp(u, 0, width - 1).long())
        depth_val = depth.reshape(-1)[flat_idx]

        trunc = torch.tensor(self.trunc_margin, dtype=torch.float32, device=dev)
        sdf = depth_val - cam_z
        valid = in_view & (depth_val > 0.0) & (sdf >= -trunc)
        dist = torch.clamp(sdf / trunc, max=1.0)

        store = self.state.tsdf.dtype
        w_old = self.state.weight.to(torch.float32)
        w_obs = torch.where(valid, obs_weight, 0.0)
        w_new = w_old + w_obs
        safe_w = torch.clamp(w_new, min=1e-12)

        tsdf_old = self.state.tsdf.to(torch.float32)
        upd = valid & (w_obs > 0.0)
        tsdf_new = torch.where(upd, torch.addcmul(dist * w_obs, tsdf_old, w_old) / safe_w,
                               tsdf_old)

        c = torch.clamp(color_im, 0.0, 255.0).to(torch.int32)
        packed_im = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
        packed = packed_im.reshape(-1)[flat_idx]
        rgb = torch.stack([(packed & 0xFF).to(torch.float32),
                           ((packed >> 8) & 0xFF).to(torch.float32),
                           ((packed >> 16) & 0xFF).to(torch.float32)])

        color_old = self.state.color.to(torch.float32)
        color_new = torch.where(upd[None],
                                torch.addcmul(rgb * w_obs[None], color_old, w_old[None])
                                / safe_w[None], color_old)

        self.state.tsdf.copy_(tsdf_new.to(store))
        self.state.weight.copy_(w_new.to(store))
        self.state.color.copy_(color_new.to(store))

    # -- extraction ----------------------------------------------------------
    def get_volume(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tsdf (X,Y,Z), weight (X,Y,Z), color (X,Y,Z,3)) as host arrays."""
        color = self.state.color.to(torch.float32).permute(1, 2, 3, 0)
        return (self.state.tsdf.to(torch.float32).cpu().numpy(),
                self.state.weight.to(torch.float32).cpu().numpy(),
                color.cpu().numpy())

    def get_mesh(self):
        """Extract the isosurface as (vertices, faces, normals, colors)."""
        from hive_tpu_torch.ops.marching import extract_isosurface

        verts, faces, colors, normals = extract_isosurface(
            self.state.tsdf.to(torch.float32), self.state.weight.to(torch.float32),
            self.state.color.to(torch.float32),
            origin=self.origin, voxel_size=self.voxel_size)

        return verts, faces, normals, colors


def world_to_camera(cam_to_world_poses) -> np.ndarray:
    """The float32 inverses of (N, 4, 4) camera-to-world poses, each as
    ``hive_tpu``'s ``jnp.linalg.inv`` computes it on the CPU: LAPACK's LU
    (``sgetrf``) and its solve (``sgetrs``) against the identity, on the
    host. ``torch.linalg.inv`` rounds some entries of a rotated pose
    otherwise, which moves the fused surface by up to ~4e-5 m."""
    from scipy.linalg import lu_factor, lu_solve

    poses = np.asarray(cam_to_world_poses, np.float32)
    eye = np.eye(4, dtype=np.float32)
    return np.stack([lu_solve(lu_factor(pose), eye) for pose in poses.reshape(-1, 4, 4)]
                    ).reshape(poses.shape)


def estimate_volume_bounds(depths, camera_matrix, cam_to_world_poses) -> np.ndarray:
    """Union of all view frusta → (3, 2) scene bounds (host side: only each
    frame's max depth matters)."""
    depths = np.asarray(depths)
    n = depths.shape[0]
    max_depths = depths.reshape(n, -1).max(axis=1)
    return estimate_volume_bounds_from_max_depths(
        max_depths, camera_matrix, cam_to_world_poses,
        image_hw=depths.shape[1:3])


def estimate_volume_bounds_from_max_depths(max_depths, camera_matrix,
                                           cam_to_world_poses,
                                           image_hw=None) -> np.ndarray:
    """Frustum-union bounds from per-frame MAX depths (O(1 frame) memory).

    ``image_hw`` defaults to the sensor size implied by the intrinsics
    (2*cx, 2*cy rounded), as in the JAX package.
    """
    poses = np.asarray(cam_to_world_poses, dtype=np.float64)
    K = np.asarray(camera_matrix, dtype=np.float64)
    K_inv = np.linalg.inv(K)

    if image_hw is None:
        image_hw = (int(round(2.0 * K[1, 2])), int(round(2.0 * K[0, 2])))
    h, w = image_hw
    n = len(max_depths)
    max_depths = np.asarray(max_depths, dtype=np.float64)

    corners = np.array([[0.0, 0.0, 1.0], [w, 0.0, 1.0], [w, h, 1.0],
                        [0.0, h, 1.0]])
    rays = corners @ K_inv.T                              # (4, 3) at depth 1

    far = rays[None] * max_depths[:, None, None]          # (N, 4, 3)
    cam_pts = np.concatenate([np.zeros((n, 1, 3)), far], axis=1)
    world = np.einsum("nij,nkj->nki", poses[:, :3, :3], cam_pts) \
        + poses[:, None, :3, 3]
    pts = world.reshape(-1, 3)

    bounds = np.zeros((3, 2), dtype=np.float32)
    bounds[:, 0] = np.minimum(0.0, pts.min(axis=0))
    bounds[:, 1] = np.maximum(0.0, pts.max(axis=0))

    return bounds
