"""The band update of one frame: CUDA kernel, plain version, wrapper.

Replaces, on the integrator's main path,
``hive_tpu/ops/pallas_sampler.py:build_patch_sampler`` (built at
``tsdf_sparse.py:1432``, called at ``:1326``) together with the trip of XLA
code around it: for every voxel of the frame's band slab rows, its camera
coordinates, the nearest pixel, the packed frame word(s) there, and the
TSDF / weight / colour running-mean update, written back in place in the
state's dtype.

State layout (the integrator's slab view): ``tsdf`` and ``weight`` are
(R, BVS) for R = nb * SUB slab rows of BVS voxels; ``color`` holds 3 * R
rows of BVS, the row of slab id ``row * SUB + sub`` and channel ``ch``
being ``(row * 3 + ch) * SUB + sub`` (at SUB = 1 the (nb, 3 * BV) block
rows with their R|G|B segments).

Inputs per call: ``ids`` (K,) int64 distinct slab ids; ``base`` (K, 3) f32,
each row's first voxel in camera coordinates (the integrator's
``slab_base``: a small ``torch.matmul``, kept outside the kernel so both
versions start from the same rounding); ``scal`` (16,) f32 from
:func:`band_scalars`; ``frames``, the packed frame words (one (H, W) int32
tensor in rgb565d16 mode, the f32 depth's bits and the 8-bit colour word in
rgb888 mode).

Rounding: the plain version's is XLA's on the CPU (the running means are
``torch.addcmul``, an FMA on the CPU and on the card; the truncation scale
multiplies by the f32 reciprocal). The kernel builds with ``-fmad=false``
and calls ``__fmaf_rn`` at exactly those two spots.

Design (``csrc/band_update.cu``): one launch per frame over every band row,
one block per slab row, each thread one (x, y) column of the row stepping
along z. Each voxel is projected, sampled, unpacked and updated in
registers; the frame (1.2 MB at VGA) stays in L2. Bound on the card: the
state of the voxels the frame updates read once and the changed values
written once (up to 20 B per voxel for a bf16 state, 40 B for f32), plus
20 B per row and each distinct frame word once.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from hive_tpu_torch.ops import cuda_build
from hive_tpu_torch.ops.band_sampler import band_sample_plain
from hive_tpu_torch.ops.fused_band import MIN_WEIGHT, MIN_Z, unpack_words

# Kernel launches (not plain-version calls) since the last reset.
launches = 0

# Layout of ``scal``: fx, fy, cx, cy, the truncation, its f32 reciprocal,
# the observation weight, then the world-to-camera rotation times the voxel
# size (3 x 3, row-major): the camera-space step per voxel along each axis.
NUM_SCALARS = 16


def band_scalars(intr: torch.Tensor, trunc: torch.Tensor, inv_trunc: torch.Tensor,
                 obs_weight: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """The (16,) f32 ``scal`` of one frame, on the device of its inputs."""
    return torch.cat([intr.reshape(4), trunc.reshape(1), inv_trunc.reshape(1),
                      obs_weight.reshape(1), step.reshape(9)]).to(torch.float32)


def voxel_offsets(block: Tuple[int, int], bvs: int, device) -> Tuple[torch.Tensor, ...]:
    """The in-slab voxel offsets (x, y, z) as f32 (BVS,) for blocks of
    ``block = (Bx, By)`` in z-major order (``i = iz*Bx*By + ix*By + iy``)."""
    bx, by = block
    flat = torch.arange(bvs, device=device)
    return tuple(x.to(torch.float32) for x in (torch.div(flat, by, rounding_mode="floor") % bx,
                                                flat % by,
                                                torch.div(flat, bx * by, rounding_mode="floor")))


def camera_coords(base: torch.Tensor, step: torch.Tensor, offsets):
    """Camera coordinates (K, BVS) x3 of every voxel: each row's base plus
    the offsets' steps, added left to right."""
    return tuple(base[:, axis][:, None] + offsets[0] * step[axis, 0]
                 + offsets[1] * step[axis, 1] + offsets[2] * step[axis, 2]
                 for axis in range(3))


def project(cam_x, cam_y, cam_z, intr, height: int, width: int):
    """Nearest pixel (u, v) int32 (half to even) and the in-view mask."""
    fx, fy, cx, cy = intr
    safe_z = torch.where(cam_z > MIN_Z, cam_z, 1.0)
    u = torch.round(fx * cam_x / safe_z + cx).to(torch.int32)
    v = torch.round(fy * cam_y / safe_z + cy).to(torch.int32)
    in_view = (cam_z > MIN_Z) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return u, v, in_view


def sample_words(frames: Sequence[torch.Tensor], vc, uc):
    """(depth (K, BVS) f32, rgb (K, 3, BVS) f32) at the clamped pixels."""
    if len(frames) == 2:  # rgb888: exact f32 depth + 8-bit colour
        depth = band_sample_plain(frames[0], vc, uc).view(torch.float32)
        packed = band_sample_plain(frames[1], vc, uc)
        rgb = torch.stack([(packed & 0xFF).to(torch.float32),
                           ((packed >> 8) & 0xFF).to(torch.float32),
                           ((packed >> 16) & 0xFF).to(torch.float32)], dim=1)
        return depth, rgb
    depth, *rgb = unpack_words(band_sample_plain(frames[0], vc, uc))  # rgb565d16
    return depth, torch.stack(rgb, dim=1)


def color_row_ids(ids: torch.Tensor, sub: int):
    """Per channel, the colour rows (units of BVS) of slab ids ``ids``."""
    rows = torch.div(ids, sub, rounding_mode="floor")
    subs = ids % sub
    return [(rows * 3 + ch) * sub + subs for ch in range(3)]


def gather_rows(state, ids: torch.Tensor, sub: int):
    """(tsdf (K, BVS), weight (K, BVS), colour (K, 3, BVS)) of slab ids
    ``ids``, in the state's dtype."""
    tsdf, weight, color = state
    rows = color.view(-1, tsdf.shape[1])
    return (tsdf[ids], weight[ids],
            torch.stack([rows[c] for c in color_row_ids(ids, sub)], dim=1))


def scatter_rows(state, ids: torch.Tensor, sub: int, rows) -> None:
    """Write ``rows`` = (tsdf, weight, colour) as :func:`gather_rows` gives
    them back into slab ids ``ids`` of ``state``, in place."""
    tsdf, weight, color = state
    t_rows, w_rows, c_rows = (x.to(tsdf.dtype) for x in rows)
    # index_copy_: the ids are distinct, and the state is the largest
    # allocation of the run.
    tsdf.index_copy_(0, ids, t_rows)
    weight.index_copy_(0, ids, w_rows)
    flat = color.view(-1, tsdf.shape[1])
    for ch, c_ids in enumerate(color_row_ids(ids, sub)):
        flat.index_copy_(0, c_ids, c_rows[:, ch])


def observe(base, scal, frames, *, block: Tuple[int, int], bvs: int):
    """What the frame says of each voxel of the rows, all (K, BVS): its
    clamped pixel (flat index), the in-view and valid masks, the sdf, and
    the colour there (K, 3, BVS)."""
    height, width = frames[0].shape
    fx, fy, cx, cy, trunc = scal[:5]
    cam_x, cam_y, cam_z = camera_coords(base, scal[7:].reshape(3, 3),
                                        voxel_offsets(block, bvs, base.device))
    u, v, in_view = project(cam_x, cam_y, cam_z, (fx, fy, cx, cy), height, width)
    vc, uc = torch.clamp(v, 0, height - 1), torch.clamp(u, 0, width - 1)
    depth, rgb = sample_words(frames, vc, uc)
    sdf = depth - cam_z
    valid = in_view & (depth > 0.0) & (sdf >= -trunc)
    return vc.long() * width + uc, in_view, valid, sdf, rgb


def band_update_plain(state, ids, base, scal, frames, *, block: Tuple[int, int],
                      sub: int) -> None:
    """The plain PyTorch version; see :func:`band_update` for the arguments."""
    t_old, w_old, c_old = (x.to(torch.float32) for x in gather_rows(state, ids, sub))
    inv_trunc, obs_weight = scal[5:7]
    _, _, valid, sdf, rgb = observe(base, scal, frames, block=block, bvs=t_old.shape[1])
    dist = torch.clamp(sdf * inv_trunc, max=1.0)
    w_obs = torch.where(valid, obs_weight, 0.0)
    w_new = w_old + w_obs
    safe_w = torch.clamp(w_new, min=MIN_WEIGHT)

    # w_obs > 0 guard: a zero obs_weight frame must be a no-op. The running
    # means are one FMA each (old * w + new * w_obs), as XLA contracts them
    # on the CPU, so the CPU tests see the JAX package's rounding.
    upd = valid & (w_obs > 0.0)
    t_new = torch.where(upd, torch.addcmul(dist * w_obs, t_old, w_old) / safe_w, t_old)
    c_new = torch.where(upd[:, None],
                        torch.addcmul(rgb * w_obs[:, None], c_old, w_old[:, None])
                        / safe_w[:, None], c_old)
    scatter_rows(state, ids, sub, (t_new, w_new, c_new))


def _launch(state, ids, base, scal, frames, block, sub):
    global launches
    lib = cuda_build.load("band_update")
    fn = lib.band_update_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int32] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 6
                   + [ctypes.c_void_p])

    tsdf, weight, color = state
    if ids.numel() == 0:
        return
    height, width = frames[0].shape
    rgb888 = len(frames) == 2
    # The runtime API launches on the current device: make the tensors' own
    # device current (another device's context cannot use their pointers).
    with torch.cuda.device(tsdf.device):
        err = fn(ids.data_ptr(), base.data_ptr(), scal.data_ptr(), ids.numel(),
                 frames[0].data_ptr(), frames[1].data_ptr() if rgb888 else None, height, width,
                 tsdf.data_ptr(), weight.data_ptr(), color.data_ptr(),
                 int(tsdf.dtype == torch.bfloat16), int(rgb888), *block, tsdf.shape[1], sub,
                 torch.cuda.current_stream(tsdf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_update kernel launch failed: CUDA error {err}")
    launches += 1


def band_update(state, ids, base, scal, frames, *, block: Tuple[int, int], sub: int) -> None:
    """Update the band slab rows ``ids`` of ``state`` = (tsdf, weight,
    color) in place with one frame: the kernel for CUDA tensors, the plain
    version for CPU tensors.

    ``ids`` (K,) int64 distinct slab ids; ``base`` (K, 3) f32 camera
    coordinates of each row's first voxel; ``scal`` (16,) f32
    (:func:`band_scalars`); ``frames`` one or two (H, W) int32 packed frames
    (rgb565d16, or rgb888's depth bits and colour); ``block`` = (Bx, By) of
    the voxel blocks; ``sub`` slab rows per block."""
    tsdf, weight, color = state
    tensors = [tsdf, weight, color, ids, base, scal, *frames]
    if not all(x.device == tsdf.device for x in tensors):
        raise ValueError("state, ids, bases, scalars and frames must share a device")
    if tsdf.dim() != 2 or tsdf.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("tsdf must be a (rows, BVS) float32 or bfloat16 tensor")
    rows, bvs = tsdf.shape
    if weight.shape != tsdf.shape or color.numel() != 3 * tsdf.numel():
        raise ValueError("weight must match tsdf and color hold 3 values per voxel")
    if weight.dtype != tsdf.dtype or color.dtype != tsdf.dtype:
        raise ValueError("tsdf, weight and color must share a dtype")
    if sub < 1 or rows % sub or bvs % (block[0] * block[1]):
        raise ValueError(f"{rows} x {bvs} slab rows do not fit blocks {block} x SUB {sub}")
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise ValueError("ids must be a (K,) int64 tensor")
    if base.shape != (ids.numel(), 3) or base.dtype != torch.float32:
        raise ValueError("base must be (K, 3) float32")
    if scal.shape != (NUM_SCALARS,) or scal.dtype != torch.float32:
        raise ValueError(f"scal must be ({NUM_SCALARS},) float32")
    if (len(frames) not in (1, 2) or any(f.dim() != 2 or f.dtype != torch.int32 for f in frames)
            or any(f.shape != frames[0].shape for f in frames)):
        raise ValueError("frames must be one or two (H, W) int32 tensors")
    if tsdf.device.type == "cpu":
        band_update_plain(state, ids, base, scal, frames, block=block, sub=sub)
        return
    if tsdf.device.type != "cuda":
        raise ValueError(f"unsupported device {tsdf.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("state, ids, bases, scalars and frames must be contiguous")
    if block[0] * block[1] > 1024:
        raise ValueError(f"a {block} z layer exceeds the kernel's 1024 threads per block")
    _launch(state, ids, base, scal, frames, block, sub)
