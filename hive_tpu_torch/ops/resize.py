"""Batched image resize and normalisation for model inputs.

Counterpart of ``hive_tpu/ops/resize.py``, with a plain PyTorch port of
``jax.image.resize``: its ``scale_and_translate`` weight matrices (the Keys
cubic kernel with a = -0.5 and the triangle kernel, widened by 1/scale when
downsampling, normalised per output, zero where the sample lies outside the
input) applied one axis at a time as a matrix product, and its nearest
resize as an index gather. ``F.interpolate`` computes other functions: its
cubic uses a = -0.75 and its antialias treats the edges differently.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 (``jax.image``'s "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


_KERNELS = {"cubic": _keys_cubic, "bilinear": _triangle}


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """The (in_size, out_size) float32 matrix that ``jax.image.resize``
    contracts one axis with (``compute_weight_mat``, antialiased, no
    translation)."""
    kernel = _KERNELS[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * _EPS32,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(np.float32)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The source index of each output of ``jax.image.resize``'s nearest
    resize: floor((i + 0.5) * in / out) in float32, the division a multiply
    by the reciprocal, as XLA computes it."""
    offsets = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) * (np.float32(1.0) / np.float32(out_size))
    return np.floor(offsets).astype(np.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)``: every axis whose size changes
    is resized on its own; an axis of the same size is left as it is. An
    integer input computes in float32, as JAX promotes it."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has another rank than the input {tuple(x.shape)}")
    if method != "nearest" and not x.is_floating_point():
        x = x.float()
    for axis, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            index = torch.from_numpy(nearest_indices(m, n)).to(x.device)
            x = x.index_select(axis, index)
        else:
            w = torch.from_numpy(weight_matrix(m, n, method)).to(x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB in [0, 255] -> float32 normalised with DPT's mean and
    std 0.5, rounded as XLA computes ``hive_tpu``'s: x * f32(1/255) - 0.5 as
    one FMA, then / 0.5."""
    images = images.float()
    scaled = torch.addcmul(torch.full_like(images, -0.5), images,
                           torch.full_like(images, float(np.float32(1.0 / 255.0))))
    return scaled / torch.full_like(images, 0.5)


def prepare_model_input(frames_uint8: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Normalise then resize (cubic) a (B, H, W, 3) batch to (B, h, w, 3):
    the DPT input transform."""
    b, _, _, c = frames_uint8.shape
    return resize(normalize(frames_uint8), (b, *size, c), "cubic")


def keep_aspect_multiple_of(source_hw: Tuple[int, int]) -> Tuple[int, int]:
    """DPT's Resize(keep_aspect_ratio=True, resize_method='minimal',
    ensure_multiple_of=32) policy towards 480 x 640: of the two axis scales
    implied by that target, take the one closest to 1, apply it to both
    axes, and round each side to a multiple of 32. One side can end up past
    its target."""
    h, w = source_hw
    scale_h, scale_w = 480 / h, 640 / w
    scale = scale_w if abs(1.0 - scale_w) < abs(1.0 - scale_h) else scale_h

    def round_multiple(x):
        return max(32, int(round(x * scale / 32)) * 32)

    return round_multiple(h), round_multiple(w)
