"""Gather inside one small tile: CUDA kernel, plain version, wrapper.

Replaces ``scripts/micro_pallas_gather.py:q1`` (``q1_lane_kernel`` and
``q1_sublane_kernel``), the probes of the TPU's in-register gathers:
``take_along_axis`` of an ``(8, 128)`` 32-bit tile along lanes (axis 1) or
sublanes (axis 0). The port serves the gather-probe entry point
(``hive_tpu_torch.micro.gather``).

Design: one block stages the tile in shared memory and each thread writes
one output word (``csrc/tile_gather.cu``); a 128-wide row spans four warps,
so ``__shfl_sync`` cannot stand in for the TPU's lane gather. Bound on the
card: 12 B per element, so the launch itself bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from hive_tpu_torch.ops import cuda_build

# Kernel launches (not plain-version calls) since the last reset.
launches = 0

# One block holds the tile: at most 1024 threads, one per element.
MAX_ELEMENTS = 1024


def tile_gather_plain(src: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The plain PyTorch version: ``take_along_axis(src, idx, axis)``."""
    return torch.gather(src, axis, idx.long())


def _launch(src, idx, axis):
    global launches
    lib = cuda_build.load("tile_gather")
    fn = lib.tile_gather_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]

    out = torch.empty_like(src)
    if src.numel() == 0:
        return out
    rows, cols = src.shape
    # The runtime API launches on the current device: make the tensors' own
    # device current (another device's context cannot use their pointers).
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), idx.data_ptr(), rows, cols, axis, out.data_ptr(),
                 torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_gather kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def tile_gather(src: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``take_along_axis`` of a 2-D int32 tile by int32 indices of its shape,
    along ``axis`` 1 (within each row) or 0 (within each column): the kernel
    for CUDA tensors, the plain version for CPU tensors. Indices must lie
    inside the tile."""
    if src.dim() != 2 or src.dtype != torch.int32:
        raise ValueError("src must be a 2-D int32 tensor")
    if idx.shape != src.shape or idx.dtype != torch.int32:
        raise ValueError("idx must be an int32 tensor of src's shape")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, not {axis}")
    if src.device != idx.device:
        raise ValueError("src and idx must share a device")
    if src.device.type == "cpu":
        return tile_gather_plain(src, idx, axis)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if src.numel() > MAX_ELEMENTS:
        raise ValueError(f"the tile holds {src.numel()} elements; one block takes "
                         f"at most {MAX_ELEMENTS}")
    return _launch(src.contiguous(), idx.contiguous(), axis)
