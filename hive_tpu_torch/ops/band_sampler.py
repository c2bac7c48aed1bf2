"""The band pass's per-voxel frame sampling: CUDA kernel, plain version, wrapper.

Replaces ``hive_tpu/ops/pallas_sampler.py:build_patch_sampler`` (built at
``tsdf_sparse.py:1432``, called at ``:1326``): for every band voxel, the
32-bit frame word at its clamped projected pixel. In rgb565d16 mode that
word is u16-mm depth | dithered RGB565; in rgb888 mode the integrator calls
it twice, on the f32 depth's bits and on the packed 8-bit colour.

Design: the TPU kernel DMA'd a tile-aligned 64x256 window per block because
Mosaic cannot gather arbitrarily, and routed blocks that did not fit to the
XLA take. Hopper gathers from any address, so ``csrc/band_sampler.cu`` runs
one thread per voxel with no window; the frame (1.2 MB at VGA) stays in
L2. Bound on the card: ~12 B per voxel, so at a 128-block trip the launch
itself, not memory, bounds it.

The integrator's band pass on the card goes through the frame-wide band
update (:mod:`hive_tpu_torch.ops.band_update`) instead; this sampler serves
the measurement entry points, as the sampler of their production trip, and
the band update's plain version uses its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from hive_tpu_torch.ops import cuda_build

# Kernel launches (not plain-version calls) since the last reset.
launches = 0


def band_sample_plain(frame: torch.Tensor, v: torch.Tensor, u: torch.Tensor):
    """The plain PyTorch version: ``frame[clamp(v), clamp(u)]``."""
    height, width = frame.shape
    vc = torch.clamp(v, 0, height - 1).long()
    uc = torch.clamp(u, 0, width - 1).long()
    return frame.reshape(-1)[vc * width + uc]


def _launch(frame, v, u):
    global launches
    lib = cuda_build.load("band_sampler")
    fn = lib.band_sample_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]

    out = torch.empty(v.shape, dtype=torch.int32, device=frame.device)
    if v.numel() == 0:
        return out
    height, width = frame.shape
    # The runtime API launches on the current device: make the tensors' own
    # device current (another device's context cannot use their pointers).
    with torch.cuda.device(frame.device):
        err = fn(frame.data_ptr(), height, width, v.data_ptr(), u.data_ptr(), v.numel(),
                 out.data_ptr(), torch.cuda.current_stream(frame.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_sampler kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def band_sample(frame: torch.Tensor, v: torch.Tensor, u: torch.Tensor):
    """Sample ``frame`` (H, W) int32 words at int32 pixel coordinates of any
    matching shape: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if frame.dim() != 2 or frame.dtype != torch.int32:
        raise ValueError("frame must be a 2-D int32 tensor")
    if v.shape != u.shape or v.dtype != torch.int32 or u.dtype != torch.int32:
        raise ValueError("v and u must be int32 tensors of one shape")
    if not (frame.device == v.device == u.device):
        raise ValueError("frame and coordinates must share a device")
    if frame.device.type == "cpu":
        return band_sample_plain(frame, v, u)
    if frame.device.type != "cuda":
        raise ValueError(f"unsupported device {frame.device}")
    if not (frame.is_contiguous() and v.is_contiguous() and u.is_contiguous()):
        raise ValueError("frame and coordinates must be contiguous")
    return _launch(frame, v, u)
