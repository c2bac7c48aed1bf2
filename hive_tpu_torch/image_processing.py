"""Image-domain helpers: mask dilation, depth filtering and binning,
inpainting and resolution math.

Counterpart of ``hive_tpu/image_processing.py`` (``dilate_mask``,
``median_filter``, ``get_bins``, ``bin_depth`` and
``calculate_target_resolution``) and of the two OpenCV calls of
``hive_tpu/dataset_adaptors.py``'s inpainting (``cv2.dilate`` of the
instance masks, :func:`dilate_ids`, and ``cv2.inpaint`` with
``INPAINT_TELEA``, :func:`inpaint_telea`) and of its video frames
(``cv2.resize`` of uint8 frames, :func:`resize_linear_u8`, and
``cv2.rotate``, :func:`rotate`). The JAX package dilates with
OpenCV; the port has no OpenCV, so a dilation by the all-ones rectangular
element becomes ``max_pool2d`` passes (stride 1, -inf padding), which is
what ``cv2.dilate`` computes with its default border. ``cv2.medianBlur``
becomes the exact median on the card with OpenCV's replicated border (a
count over the 256 levels from integral images for 8-bit maps, a sort of
each window for the 3x3 and 5x5 float filters). Telea's inpainting is a
sequential fast march, host code in the native library.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from hive_tpu_torch import get_device
from hive_tpu_torch.native import telea_inpaint
from hive_tpu_torch.options import MaskDilationOptions
from hive_tpu_torch.utils import validate_shape


def dilate_mask(mask, dilation_options: MaskDilationOptions, device="cpu"):
    """Grow a binary/instance mask by repeated morphological dilation.

    :param mask: The (H, W) mask to enlarge (numpy array or tensor).
    :param dilation_options: Structuring element size + iteration count.
    :param device: where the pooling runs; a numpy mask comes back as a
        numpy array, a tensor as a tensor on ``device``.
    :return: The dilated boolean mask.
    """
    validate_shape(mask, "mask", expected_shape=(None, None))
    as_numpy = isinstance(mask, np.ndarray)

    x = torch.as_tensor(np.asarray(mask, np.float32) if as_numpy else mask,
                        device=device).to(torch.float32)
    out = _dilate(x, int(dilation_options.filter_size), dilation_options.num_iterations) != 0
    return out.cpu().numpy() if as_numpy else out


def _dilate(x: torch.Tensor, k: int, iterations: int) -> torch.Tensor:
    """``cv2.dilate`` of the (H, W) float map ``x`` by the all-ones k x k
    element, ``iterations`` times. cv2 anchors the element at k // 2:
    output(p) is the max over p - k//2 .. p + (k - 1 - k//2) on each axis,
    pixels outside the frame ignored."""
    if iterations <= 0:
        return x
    lo, hi = k // 2, k - 1 - k // 2
    x = x[None, None]
    for _ in range(iterations):
        x = F.max_pool2d(F.pad(x, (lo, hi, lo, hi), value=-float("inf")), kernel_size=k,
                         stride=1)
    return x[0, 0]


def dilate_ids(mask: np.ndarray) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((5, 5), np.uint8), iterations=5)`` on a
    uint8 instance-id mask: each pixel takes the largest id within 10
    pixels on each axis (a 21 x 21 window), pixels outside the frame
    ignored. The ids stay ids; :func:`dilate_mask` returns booleans."""
    validate_shape(mask, "mask", expected_shape=(None, None))
    x = _dilate(torch.from_numpy(np.asarray(mask, np.float32)), 5, 5)
    return x.numpy().astype(np.uint8)


def _replicated(x: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) ``x`` padded by ``r`` on each side, edges replicated."""
    height, width = x.shape
    rows = torch.clamp(torch.arange(-r, height + r, device=x.device), 0, height - 1)
    cols = torch.clamp(torch.arange(-r, width + r, device=x.device), 0, width - 1)
    return x[rows][:, cols]


# Levels counted at once by _median_u8.
_MEDIAN_LEVELS = 32


def _median_u8(x: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur`` of an (H, W) uint8 map, any odd ``k``: the median
    of each k x k window is the number of levels L < 255 whose count of
    window values <= L stays below (k^2 + 1) / 2; the counts are box sums of
    an integral image per level."""
    height, width = x.shape
    padded = _replicated(x, k // 2)
    half = (k * k + 1) // 2
    median = torch.zeros((height, width), dtype=torch.int32, device=x.device)
    for start in range(0, 255, _MEDIAN_LEVELS):
        levels = torch.arange(start, min(start + _MEDIAN_LEVELS, 255), device=x.device,
                              dtype=torch.uint8)
        below = (padded[None] <= levels[:, None, None]).to(torch.int32)
        integral = F.pad(below.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32),
                         (1, 0, 1, 0))
        box = (integral[:, k:, k:] - integral[:, :height, k:] - integral[:, k:, :width]
               + integral[:, :height, :width])
        median += (box < half).sum(dim=0, dtype=torch.int32)
    return median.to(torch.uint8)


def _median_sorted(x: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur`` with a 3x3 or 5x5 window, any dtype: the middle
    value of each window."""
    height, width = x.shape
    windows = _replicated(x, k // 2).unfold(0, k, 1).unfold(1, k, 1)
    return windows.reshape(height, width, k * k).median(dim=-1).values


def median_filter(depth_map: np.ndarray, kernel_size: int = 63, device=None) -> np.ndarray:
    """Median-filter a depth map (NYU convention: invalid = 0, max = 10.0).

    Kernels larger than 5 px filter the map rescaled to uint8, then rescale
    back to float32, as ``hive_tpu`` does for ``cv2.medianBlur``; numpy's
    dtypes are kept (float32 minus a Python float stays float32).

    :param device: where the filter runs; default ``cuda:0``.
    """
    device = get_device(device)
    depth = torch.as_tensor(np.ascontiguousarray(depth_map), device=device)

    if kernel_size > 5:
        min_depth = float(depth_map.min())
        max_depth = float(depth_map.max())
        span = max(max_depth - min_depth, 1e-12)

        # (255 * (depth - min) / span).astype(uint8), a true division by
        # span as numpy's dtype.
        scaled = 255 * (depth - min_depth) / torch.full_like(depth, span)
        filtered = _median_u8(scaled.to(torch.uint8), kernel_size).to(torch.float32)
        out = (filtered / torch.full_like(filtered, 255.0)) * span + min_depth
        return out.cpu().numpy()

    return _median_sorted(depth, kernel_size).cpu().numpy()


def get_bins(min_value: float = 0.0, max_value: float = 10.0, num_bins: int = 128) -> np.ndarray:
    """Log-spaced depth bins following "Deep Ordinal Regression Network for
    Monocular Depth Estimation" (https://arxiv.org/abs/1806.02446)."""
    epsilon = 1.0 - min_value
    alpha = min_value + epsilon
    beta = max_value + epsilon

    i = np.arange(num_bins)
    thresholds = np.exp(np.log(alpha) + np.log(beta / alpha) * i / num_bins) - epsilon

    return np.append(thresholds, max_value)


def bin_depth(depth_map: np.ndarray, min_depth: float = 0.0, max_depth: float = 10.0,
              num_bins: int = 128) -> np.ndarray:
    """Quantise depth values into ordered bins of increasing size; depths at
    or above the last edge (the NYU cap) fall in the last bin."""
    bins = get_bins(min_depth, max_depth, num_bins=num_bins)
    indices = np.minimum(np.digitize(depth_map, bins), len(bins) - 1)
    return bins[indices]


# The inpainting radius hive_tpu passes to cv2.inpaint.
TELEA_RADIUS = 30


def inpaint_telea(image: np.ndarray, hole: np.ndarray, radius: float = TELEA_RADIUS) -> np.ndarray:
    """``cv2.inpaint(image, hole, radius, cv2.INPAINT_TELEA)`` bit for bit
    (OpenCV 5.0.0): Telea's fast-marching inpainting of the pixels where
    ``hole`` is non-zero, from the known pixels within ``radius``.

    :param image: (H, W, 3) or (H, W) uint8, or (H, W) uint16. Channels are
        filled independently, so their order does not matter.
    :param hole: (H, W) uint8; non-zero marks the pixels to fill.
    :return: the inpainted copy, of ``image``'s shape and dtype.
    :raises RuntimeError: without the native library (no C++ compiler).
    """
    out = telea_inpaint(image, hole, radius)
    if out is None:
        raise RuntimeError("Telea inpainting needs the native library, which could not be built "
                           "(is g++ on PATH?)")
    return out


def _orientation(hw) -> str:
    """'portrait' when height is the long (or tied) side, else 'landscape'."""
    return "portrait" if hw[0] >= hw[1] else "landscape"


# cv2.rotate's codes (cv2.ROTATE_90_CLOCKWISE, ROTATE_180,
# ROTATE_90_COUNTERCLOCKWISE) as quarter turns counterclockwise.
ROTATE_90_CLOCKWISE, ROTATE_180, ROTATE_90_COUNTERCLOCKWISE = 0, 1, 2
_QUARTER_TURNS = {ROTATE_90_CLOCKWISE: -1, ROTATE_180: 2, ROTATE_90_COUNTERCLOCKWISE: 1}


def rotate(image, code: int):
    """``cv2.rotate(image, code)``: a numpy array or a tensor (on any
    device), (H, W) or (H, W, C); the same type comes back."""
    if isinstance(image, np.ndarray):
        return np.ascontiguousarray(np.rot90(image, _QUARTER_TURNS[code]))
    return torch.rot90(image, _QUARTER_TURNS[code], dims=(0, 1)).contiguous()


# OpenCV's INTER_RESIZE_COEF_BITS: the linear weights in 11-bit fixed point.
_COEF_SCALE = 2048


def _linear_taps(n_in: int, n_out: int, clamp: bool, device):
    """cv2.resize's INTER_LINEAR taps along one axis (``resize.cpp``): the
    source coordinate ``(d + 0.5) * scale - 0.5`` rounded to float32 (the
    scale is ``1 / (n_out / n_in)`` in double), its floor and fraction, the
    two weights ``saturate_cast<short>(w * 2048)``. Along x (``clamp``) a
    tap left of 0 or right of the last pixel takes that pixel with weight
    2048; along y the weights stay and only the rows are clamped."""
    position = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    low = np.floor(position).astype(np.int64)
    frac = (position - low.astype(np.float32)).astype(np.float32)
    if clamp:
        outside = (low < 0) | (low >= n_in - 1)
        frac[outside] = 0
        low = np.clip(low, 0, n_in - 1)
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE)).astype(np.int32)
    taps = (np.clip(low, 0, n_in - 1), np.clip(low + 1, 0, n_in - 1), w0, w1)
    return [torch.from_numpy(t).to(device) for t in taps]


def resize_linear_u8(image, width: int, height: int):
    """``cv2.resize(image, (width, height))`` (INTER_LINEAR) of a uint8
    image, (H, W) or (H, W, C), bit for bit as OpenCV 5.0.0
    computes it: the horizontal pass in exact integers with 11-bit weights,
    then the vertical pass in its SIMD form, ``(((S0 >> 4) * b0 >> 16) +
    ((S1 >> 4) * b1 >> 16) + 2) >> 2``, saturated to uint8. A numpy array
    is resized on the CPU and comes back as one; a tensor on its device."""
    as_numpy = isinstance(image, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(image)) if as_numpy else image
    if x.dtype != torch.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8 images, not {x.dtype}")
    in_h, in_w = x.shape[:2]
    if (in_w, in_h) == (width, height):
        out = x.clone()
    else:
        x0, x1, a0, a1 = _linear_taps(in_w, width, True, x.device)
        y0, y1, b0, b1 = _linear_taps(in_h, height, False, x.device)
        src = x.to(torch.int32)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        rows = src[:, x0] * a0.view(shape) + src[:, x1] * a1.view(shape)
        shape = (-1,) + (1,) * (x.dim() - 1)
        out = ((((rows[y0] >> 4) * b0.view(shape)) >> 16)
               + (((rows[y1] >> 4) * b1.view(shape)) >> 16) + 2) >> 2
        out = out.clamp_(0, 255).to(torch.uint8)
    return out.numpy() if as_numpy else out


def calculate_target_resolution(source_hw, target_hw):
    """Resolve a resize spec into a concrete (height, width) pair.

    * an **int** — the desired length of the *longest* side; the short side
      scales proportionally (truncated to int);
    * a **(height, width) tuple of ints** — taken as-is after validation.

    Warnings are logged when the resolved shape flips orientation or changes
    the aspect ratio relative to the source frames.
    """
    src_h, src_w = int(source_hw[0]), int(source_hw[1])

    if isinstance(target_hw, int):
        if src_h >= src_w:
            resolved = (target_hw, int(src_w * (target_hw / src_h)))
        else:
            resolved = (int(src_h * (target_hw / src_w)), target_hw)
    else:
        if not isinstance(target_hw, tuple) or len(target_hw) != 2:
            raise ValueError(
                "A target resolution must be an int (longest side) or a "
                f"(height, width) pair; got {target_hw!r}.")
        if not all(isinstance(side, int) for side in target_hw):
            raise ValueError(
                "Both sides of a (height, width) target resolution must be "
                f"ints; got types ({type(target_hw[0]).__name__}, "
                f"{type(target_hw[1]).__name__}).")
        resolved = target_hw

    if _orientation(resolved) != _orientation((src_h, src_w)):
        logging.warning(
            f"Resizing {_orientation((src_h, src_w))} source frames "
            f"(w{src_w} x h{src_h}) to a {_orientation(resolved)} target "
            f"(w{resolved[1]} x h{resolved[0]}) — height/width may be swapped.")

    source_aspect = round(src_w / src_h, 2)
    target_aspect = round(resolved[1] / resolved[0], 2)

    if abs(source_aspect - target_aspect) > 1e-8:
        logging.warning(
            f"Source frames have aspect ratio {source_aspect:.2f} but the "
            f"target resolution has {target_aspect:.2f}; resized images "
            f"will be stretched.")

    return tuple(resolved)
