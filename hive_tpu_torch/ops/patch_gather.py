"""Per-block samples of a frame window: CUDA kernel, plain version, wrapper.

Replaces ``scripts/micro_pallas_gather.py:make_pallas_fn``, the TPU's
16 x 256 window-sampler prototype: block ``b`` samples the frame at pixel
coordinates ``(vv[b], uu[b])`` from the ``ph x pw`` window at
``(v0[b], u0[b])``, and a coordinate outside the window gives 0. The port
serves the gather-probe entry point (``hive_tpu_torch.micro.gather``).

Design: no staging (``csrc/patch_gather.cu``). Each thread takes four
consecutive samples of one block, loads their coordinates as one int4 each
and its block's origin once, reads each in-window word straight from the
frame (in L2) and stores the four as one int4. Bound on the card: ~12 B
per sample.
"""

from __future__ import annotations

import ctypes

import torch

from hive_tpu_torch.ops import cuda_build

# Kernel launches (not plain-version calls) since the last reset.
launches = 0


def patch_gather_plain(v0, u0, frame, vv, uu, ph: int = 16, pw: int = 256):
    """The plain PyTorch version. The window of block ``b`` starts at
    ``(v0[b], u0[b])`` clamped into the frame (where ``lax.dynamic_slice``
    puts a window that would leave it); in-window offsets are taken from the
    unclamped origin, as the TPU kernel takes them."""
    height, width = frame.shape
    shape = (v0.shape[0],) + (1,) * (vv.dim() - 1)
    v0, u0 = v0.reshape(shape), u0.reshape(shape)
    wv = torch.clamp(v0, 0, height - ph)
    wu = torch.clamp(u0, 0, width - pw)
    pv, pu = vv - v0, uu - u0
    inside = (pv >= 0) & (pv < ph) & (pu >= 0) & (pu < pw)
    row = (wv + torch.clamp(pv, 0, ph - 1)).long()
    col = (wu + torch.clamp(pu, 0, pw - 1)).long()
    return torch.where(inside, frame.reshape(-1)[row * width + col], 0)


def _launch(v0, u0, frame, vv, uu, ph, pw):
    global launches
    lib = cuda_build.load("patch_gather")
    fn = lib.patch_gather_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_void_p]

    out = torch.empty(vv.shape, dtype=torch.int32, device=frame.device)
    blocks = v0.shape[0]
    if vv.numel() == 0:
        return out
    height, width = frame.shape
    # The runtime API launches on the current device: make the tensors' own
    # device current (another device's context cannot use their pointers).
    with torch.cuda.device(frame.device):
        err = fn(frame.data_ptr(), height, width, v0.data_ptr(), u0.data_ptr(), vv.data_ptr(),
                 uu.data_ptr(), blocks, ph, pw, vv.numel() // blocks, out.data_ptr(),
                 torch.cuda.current_stream(frame.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"patch_gather kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def patch_gather(v0, u0, frame, vv, uu, ph: int = 16, pw: int = 256):
    """Per-block window samples: ``frame`` (H, W) int32 words, window
    origins ``v0``/``u0`` (NB,) int32, absolute pixel coordinates
    ``vv``/``uu`` int32 of shape (NB, ...). Returns the words at the
    coordinates, 0 where a coordinate leaves its block's window: the kernel
    for CUDA tensors (a multiple of four samples per block), the plain
    version for CPU tensors."""
    if frame.dim() != 2 or frame.dtype != torch.int32:
        raise ValueError("frame must be a 2-D int32 tensor")
    if any(x.dtype != torch.int32 for x in (v0, u0, vv, uu)):
        raise ValueError("window origins and coordinates must be int32")
    if v0.dim() != 1 or u0.shape != v0.shape:
        raise ValueError("v0 and u0 must be (NB,) tensors")
    if vv.shape != uu.shape or vv.dim() < 1 or vv.shape[0] != v0.shape[0]:
        raise ValueError("vv and uu must share a shape (NB, ...)")
    if not (0 < ph <= frame.shape[0] and 0 < pw <= frame.shape[1]):
        raise ValueError(f"a {ph} x {pw} window does not fit a {tuple(frame.shape)} frame")
    if not all(x.device == frame.device for x in (v0, u0, vv, uu)):
        raise ValueError("frame, origins and coordinates must share a device")
    if frame.device.type == "cpu":
        return patch_gather_plain(v0, u0, frame, vv, uu, ph, pw)
    if frame.device.type != "cuda":
        raise ValueError(f"unsupported device {frame.device}")
    v0, u0, frame, vv, uu = (x.contiguous() for x in (v0, u0, frame, vv, uu))
    # The kernel loads and stores four samples of one block as an int4.
    if vv.numel() // max(1, v0.numel()) % 4 or any(x.data_ptr() % 16 for x in (vv, uu)):
        raise ValueError("the kernel takes a multiple of 4 samples per block, in "
                         "16-byte aligned coordinates")
    return _launch(v0, u0, frame, vv, uu, ph, pw)
