"""Histograms summed in a fixed order: CUDA kernel, plain version, wrapper.

Replaces no TPU kernel. SIFT's orientation and descriptor histograms
(``ops/sift.py``) add float32 values into bins with OpenCV's order of
samples: each bin starts at 0 and takes its entries in entry order, one
rounded add each. ``scatter_add_`` does that on the CPU, but on CUDA it
adds with atomics in no fixed order, so the card's sums, and so its
keypoints, descriptors and MIFD, moved from run to run and off the CPU's.
This kernel (``csrc/ordered_hist.cu``) sums in entry order on the card.

Design: one warp owns one row, four rows a block, each with its own
histogram in shared memory. The warp takes 32 consecutive entries a step,
lane order being entry order; the lanes that hit one bin form a group
(``__match_any_sync``), and its lowest lane adds its own value and then
its peers' in lane order, one ``__fadd_rn`` each, into the bin's running
value: each bin still takes its entries in entry order. Entries outside
``[0, bins)`` or with a value of +0 or -0 are skipped, which is exact (the
sum starts at +0, never becomes -0, and is unchanged by adding a zero).
Each warp stages its row through a ring in shared memory with
``cp.async``, the next 256 entries in flight while it sums the current
256. Bound on the card: 8 bytes an entry read and 4 bytes a bin written,
over 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch

from hive_tpu_torch.ops import cuda_build

# Kernel launches (not plain-version calls) since the last reset.
launches = 0

# Rows a block sums (one warp each), and the most bins a row may have:
# 4 rows x 512 bins x 4 B = 8 KB of histograms beside 16 KB of staging
# rings, within the 48 KB a block may use without asking.
WARPS_PER_BLOCK = 4
MAX_BINS = 512


def ordered_hist_plain(index: torch.Tensor, value: torch.Tensor, bins: int) -> torch.Tensor:
    """The plain PyTorch version: ``scatter_add_`` into zeros, which on the
    CPU adds each row's entries in entry order."""
    out = torch.zeros((index.shape[0], bins), dtype=torch.float32, device=index.device)
    return out.scatter_add_(1, index.long(), value)


def _launch(index: torch.Tensor, value: torch.Tensor, bins: int) -> torch.Tensor:
    global launches
    lib = cuda_build.load("ordered_hist")
    fn = lib.ordered_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]

    rows, entries = index.shape
    out = torch.empty((rows, bins), dtype=torch.float32, device=index.device)
    if rows == 0:
        return out
    # The runtime API launches on the current device: make the tensors' own
    # device current (another device's context cannot use their pointers).
    with torch.cuda.device(index.device):
        err = fn(index.data_ptr(), value.data_ptr(), rows, entries, bins, out.data_ptr(),
                 torch.cuda.current_stream(index.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ordered_hist kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def ordered_hist(index: torch.Tensor, value: torch.Tensor, bins: int) -> torch.Tensor:
    """(rows, bins) float32 sums of ``value`` by ``index``, each row's
    entries added in entry order from 0: the kernel for CUDA tensors, the
    plain version for CPU tensors.

    :param index: (rows, E) int32 bin of each entry, in [0, bins) (the
        kernel skips an entry outside it; the plain version raises).
    :param value: (rows, E) float32.
    """
    if index.dim() != 2 or index.dtype != torch.int32:
        raise ValueError("index must be a 2-D int32 tensor")
    if value.shape != index.shape or value.dtype != torch.float32:
        raise ValueError("value must be a float32 tensor of index's shape")
    if index.device != value.device:
        raise ValueError("index and value must share a device")
    if index.device.type == "cpu":
        return ordered_hist_plain(index, value, bins)
    if index.device.type != "cuda":
        raise ValueError(f"unsupported device {index.device}")
    if not 0 < bins <= MAX_BINS:
        raise ValueError(f"bins must be in [1, {MAX_BINS}], not {bins}")
    return _launch(index.contiguous(), value.contiguous(), bins)
