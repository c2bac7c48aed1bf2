"""One fused band trip over gathered state rows: CUDA kernel, plain version,
wrapper, and the trip's three stages that the plain version shares.

Replaces ``scripts/micro_pallas_fused_band.py:make_fused``: for each row of
a trip (one 8^3 block, ``BV`` = 512 voxels), project every voxel into the
frame (``project_in_kernel=True``) or take its coordinates from outside
(``False``, "half-fused"), sample the packed frame word inside the row's
``ph x pw`` window, unpack it, and apply the band's TSDF / weight / colour
running-mean update. Rows come in gathered and go out updated, in place;
row gather and scatter stay in torch. The port serves the fused-trip entry
point (``hive_tpu_torch.micro.fused_band``).

The three stages (``project``, ``unpack_words``, ``update_math``) are the
script's, shared verbatim by the plain version and the entry point's
production trip. Their rounding is XLA's on the CPU, so the plain version
equals the interpreted Pallas kernel bit for bit: the two FMAs per
projection row and the two running means are ``torch.addcmul`` (an FMA on
the CPU and on the card), and the truncation scale multiplies by the f32
reciprocal, as XLA rewrites ``x / const``.

Design: one block per row, one thread per voxel (``csrc/fused_band.cu``);
each voxel reads its word from the frame in L2 at the window-clamped pixel
instead of staging the 64 KB window. Bound on the card: ~40 B of row state
per voxel in and out.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from hive_tpu_torch.ops import cuda_build

# Kernel launches (not plain-version calls) since the last reset.
launches = 0

MIN_Z = 1e-6
MIN_WEIGHT = 1e-12


def f32_reciprocal(x: float) -> float:
    """1 / x rounded to f32, as XLA folds the reciprocal of a constant."""
    return float(np.float32(1.0) / np.float32(x))


def project(origins, R, t, iota, intr: Sequence[float]):
    """(cam_z, u, v), each (K, BV): camera depth and rounded pixel of every
    voxel of each row, the voxel at ``origins[k] + iota[:, i]`` in the world."""
    fx, fy, cx, cy = intr
    wx = origins[:, 0:1] + iota[0][None, :]
    wy = origins[:, 1:2] + iota[1][None, :]
    wz = origins[:, 2:3] + iota[2][None, :]

    def cam(k):
        return torch.addcmul(torch.addcmul(R[k, 0] * wx, wy, R[k, 1]), wz, R[k, 2]) + t[k]

    cam_x, cam_y, cam_z = cam(0), cam(1), cam(2)
    safe_z = torch.where(cam_z > MIN_Z, cam_z, 1.0)
    u = torch.round(fx * cam_x / safe_z + cx).to(torch.int32)
    v = torch.round(fy * cam_y / safe_z + cy).to(torch.int32)
    return cam_z, u, v


def unpack_words(w):
    """(depth m, r, g, b) f32 from rgb565d16 words (u16 mm | RGB565 << 16)."""
    def f32(x):
        return x.to(torch.float32)

    depth = f32(w & 0xFFFF) * 1e-3
    r = f32((w >> 16) & 31) * (255.0 / 31.0)
    g = f32((w >> 21) & 63) * (255.0 / 63.0)
    b = f32((w >> 27) & 31) * (255.0 / 31.0)
    return depth, r, g, b


def update_math(t_old, w_old, c_old, depth, rgb, cz, in_view, valid_row, obs_weight,
                trunc: float):
    """The band update: (tsdf, weight, [3 colour channels]) after one
    observation. ``valid_row`` False leaves tsdf and colour as they were."""
    sdf = depth - cz
    valid = in_view & (depth > 0.0) & (sdf >= -trunc) & valid_row
    dist = torch.clamp(sdf * f32_reciprocal(trunc), max=1.0)
    w_obs = torch.where(valid, obs_weight, 0.0)
    w_new = w_old + w_obs
    safe_w = torch.clamp(w_new, min=MIN_WEIGHT)
    t_new = torch.where(valid, torch.addcmul(dist * w_obs, t_old, w_old) / safe_w, t_old)
    c_new = [torch.where(valid, torch.addcmul(rv * w_obs, c, w_old) / safe_w, c)
             for c, rv in zip(c_old, rgb)]
    return t_new, w_new, c_new


def window_sample(frame, win_v0, win_u0, v, u, ph: int, pw: int):
    """The word at each voxel's clamped pixel, clamped once more into its
    row's window (a lane outside the window reads the window's edge word)."""
    height, width = frame.shape
    v0, u0 = win_v0[:, None], win_u0[:, None]
    pv = torch.clamp(torch.clamp(v, 0, height - 1) - v0, 0, ph - 1)
    pu = torch.clamp(torch.clamp(u, 0, width - 1) - u0, 0, pw - 1)
    row = (torch.clamp(v0, 0, height - ph) + pv).long()
    col = (torch.clamp(u0, 0, width - pw) + pu).long()
    return frame.reshape(-1)[row * width + col]


def fused_band_plain(win_v0, win_u0, valid, scal, origins, frame, coords, tsdf, weight,
                     color, *, project_in_kernel: bool, intr: Sequence[float],
                     trunc: float, window: Tuple[int, int]):
    """The plain PyTorch version; see ``fused_band`` for the arguments."""
    height, width = frame.shape
    k, bv = tsdf.shape
    obs_weight, R, t = scal[0], scal[1:10].reshape(3, 3), scal[10:13]
    if project_in_kernel:
        cz, u, v = project(origins, R, t, coords, intr)
    else:
        v, u, cz = coords
    in_view = (cz > MIN_Z) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    w = window_sample(frame, win_v0, win_u0, v, u, *window)
    depth, r, g, b = unpack_words(w)
    colour = color.view(k, 3, bv)
    t_new, w_new, c_new = update_math(tsdf, weight, colour.unbind(1), depth, (r, g, b), cz,
                                      in_view, (valid > 0)[:, None], obs_weight, trunc)
    tsdf.copy_(t_new)
    weight.copy_(w_new)
    colour.copy_(torch.stack(c_new, dim=1))
    return tsdf, weight, color


def _launch(project_in_kernel, win_v0, win_u0, valid, scal, origins, frame, coords, tsdf,
            weight, color, intr, trunc, window):
    global launches
    lib = cuda_build.load("fused_band")
    fn = lib.fused_band_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
                   + [ctypes.c_void_p] * 12 + [ctypes.c_int32] * 4 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p])

    k, bv = tsdf.shape
    if k == 0:
        return tsdf, weight, color
    if project_in_kernel:
        pointers = [origins.data_ptr(), coords.data_ptr(), None, None, None]
    else:
        pointers = [None, None] + [x.data_ptr() for x in coords]
    height, width = frame.shape
    # The runtime API launches on the current device: make the tensors' own
    # device current (another device's context cannot use their pointers).
    with torch.cuda.device(frame.device):
        err = fn(int(project_in_kernel), frame.data_ptr(), height, width, win_v0.data_ptr(),
                 win_u0.data_ptr(), valid.data_ptr(), scal.data_ptr(), *pointers,
                 tsdf.data_ptr(), weight.data_ptr(), color.data_ptr(), k, bv, *window, *intr,
                 trunc, f32_reciprocal(trunc), torch.cuda.current_stream(frame.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_band kernel launch failed: CUDA error {err}")
    launches += 1
    return tsdf, weight, color


def fused_band(win_v0, win_u0, valid, scal, origins, frame, coords, tsdf, weight, color, *,
               project_in_kernel: bool, intr: Sequence[float], trunc: float,
               window: Tuple[int, int]):
    """One band trip over K gathered rows of BV voxels, updated in place.

    ``win_v0``/``win_u0`` (K,) int32 window origins inside the frame;
    ``valid`` (K,) int32, 0 for a dummy row; ``scal`` (13,) f32: the
    observation weight, then R (3x3, row-major) and t (3) of world to
    camera; ``origins`` (K, 3) f32 block origins; ``frame`` (H, W) int32
    packed words; ``coords``: the (3, BV) f32 in-block voxel offsets when
    ``project_in_kernel``, else ``(v, u, cam_z)`` of (K, BV) int32, int32,
    f32; ``tsdf``/``weight`` (K, BV) and ``color`` (K, 3 * BV) f32 rows,
    channel-major. ``intr`` is (fx, fy, cx, cy), ``trunc`` the truncation
    distance, ``window`` (ph, pw). Returns ``(tsdf, weight, color)``: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    tensors = [win_v0, win_u0, valid, scal, origins, frame, tsdf, weight, color]
    tensors += [coords] if project_in_kernel else list(coords)
    if not all(x.device == frame.device for x in tensors):
        raise ValueError("every tensor of the trip must share one device")
    if frame.dim() != 2 or frame.dtype != torch.int32:
        raise ValueError("frame must be a 2-D int32 tensor")
    if tsdf.dim() != 2 or any(x.dtype != torch.float32 for x in (tsdf, weight, color, scal)):
        raise ValueError("rows and scalars must be float32, tsdf (K, BV)")
    k, bv = tsdf.shape
    if weight.shape != (k, bv) or color.shape != (k, 3 * bv) or scal.shape != (13,):
        raise ValueError("weight must be (K, BV), color (K, 3 * BV), scal (13,)")
    if any(x.shape != (k,) or x.dtype != torch.int32 for x in (win_v0, win_u0, valid)):
        raise ValueError("window origins and valid flags must be (K,) int32")
    if origins.shape != (k, 3) or origins.dtype != torch.float32:
        raise ValueError("origins must be (K, 3) float32")
    if project_in_kernel:
        if coords.shape != (3, bv) or coords.dtype != torch.float32:
            raise ValueError("the voxel offsets must be (3, BV) float32")
    elif (tuple(x.shape for x in coords) != ((k, bv),) * 3
          or [x.dtype for x in coords] != [torch.int32, torch.int32, torch.float32]):
        raise ValueError("coords must be (v, u, cam_z) of (K, BV) int32, int32, float32")
    ph, pw = window
    if not (0 < ph <= frame.shape[0] and 0 < pw <= frame.shape[1]):
        raise ValueError(f"a {ph} x {pw} window does not fit a {tuple(frame.shape)} frame")
    options = dict(project_in_kernel=project_in_kernel, intr=intr, trunc=trunc,
                   window=window)
    if frame.device.type == "cpu":
        return fused_band_plain(win_v0, win_u0, valid, scal, origins, frame, coords, tsdf,
                                weight, color, **options)
    if frame.device.type != "cuda":
        raise ValueError(f"unsupported device {frame.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("every tensor of the trip must be contiguous")
    return _launch(project_in_kernel, win_v0, win_u0, valid, scal, origins, frame, coords,
                   tsdf, weight, color, intr, trunc, window)
