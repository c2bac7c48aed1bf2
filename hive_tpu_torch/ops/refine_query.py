"""The refine pass's 5x5 pyramid query: CUDA kernel, plain version, wrapper.

Replaces ``hive_tpu/ops/pallas_refine.py:_build_kernel`` (called through
``query_flat_pyramid_pallas`` from ``refine_band``). For each band block it
reduces the 5x5 cells of pyramid level ``ceil(log2 extent) - 2`` to
(dmin, dmax, all_valid), bit-identical to
``query_flat_pyramid(grid=5, level_bias=-2)``.

Design: the shared torch function ``pyramid_cell_bounds`` picks the level
and clamps the cells (THE definition, kept out of CUDA); the kernel
(``csrc/refine_query.cu``) runs one thread per block over the <= 25 cells,
reducing the integer fields and decoding once. The TPU kernel's DMA row
ladder, ``(rows, 128)`` view and SMEM chunking existed for Mosaic and do not
carry over. Bound on the card: ~133 B per block, so at the main path's
4096 blocks the launch itself, not memory, bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from hive_tpu_torch.ops import cuda_build

# Kernel launches (not plain-version calls) since the last reset.
launches = 0

GRID, LEVEL_BIAS = 5, -2


def refine_query_plain(pyramid, off, w_l, cu0, cu1, cv0, cv1):
    """The plain PyTorch version over precomputed cell bounds."""
    from hive_tpu_torch.ops.tsdf_sparse import query_cells

    return query_cells(pyramid, off, w_l, cu0, cu1, cv0, cv1, GRID)


def _launch(pyramid, cells):
    global launches
    lib = cuda_build.load("refine_query")
    fn = lib.refine_query_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

    n = cells.shape[1]
    dmin = torch.empty((n,), dtype=torch.float32, device=pyramid.device)
    dmax = torch.empty((n,), dtype=torch.float32, device=pyramid.device)
    valid = torch.empty((n,), dtype=torch.uint8, device=pyramid.device)
    if n == 0:
        return dmin, dmax, valid.bool()
    err = fn(pyramid.data_ptr(), pyramid.numel(), cells.data_ptr(), n,
             dmin.data_ptr(), dmax.data_ptr(), valid.data_ptr(),
             torch.cuda.current_stream(pyramid.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"refine_query kernel launch failed: CUDA error {err}")
    launches += 1
    return dmin, dmax, valid.bool()


def refine_query_cells(pyramid, off, w_l, cu0, cu1, cv0, cv1):
    """(dmin, dmax, all_valid) over precomputed cell bounds: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if pyramid.device.type == "cpu":
        return refine_query_plain(pyramid, off, w_l, cu0, cu1, cv0, cv1)
    if pyramid.device.type != "cuda":
        raise ValueError(f"unsupported device {pyramid.device}")
    if pyramid.dtype != torch.int32 or pyramid.dim() != 1 or not pyramid.is_contiguous():
        raise ValueError("pyramid must be a contiguous 1-D int32 tensor")
    cells = torch.stack([x.to(torch.int32) for x in (off, w_l, cu0, cu1, cv0, cv1)])
    if cells.device != pyramid.device:
        raise ValueError("cell bounds and pyramid must share a device")
    return _launch(pyramid, cells.contiguous())


def refine_query(pyramid, layout, u0, u1, v0, v1, height: int, width: int):
    """Drop-in for ``query_flat_pyramid(grid=5, level_bias=-2)``."""
    from hive_tpu_torch.ops.tsdf_sparse import pyramid_cell_bounds

    return refine_query_cells(pyramid, *pyramid_cell_bounds(
        layout, u0, u1, v0, v1, height, width, LEVEL_BIAS))
