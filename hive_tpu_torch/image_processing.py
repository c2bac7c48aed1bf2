"""Image-domain helpers: mask dilation, inpainting and resolution math.

Counterpart of ``hive_tpu/image_processing.py`` (``dilate_mask`` and
``calculate_target_resolution``) and of the two OpenCV calls of
``hive_tpu/dataset_adaptors.py``'s inpainting (``cv2.dilate`` of the
instance masks, :func:`dilate_ids`, and ``cv2.inpaint`` with
``INPAINT_TELEA``, :func:`inpaint_telea`). The JAX package dilates with
OpenCV; the port has no OpenCV, so a dilation by the all-ones rectangular
element becomes ``max_pool2d`` passes (stride 1, -inf padding), which is
what ``cv2.dilate`` computes with its default border. Telea's inpainting is
a sequential fast march, host code in the native library.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

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
