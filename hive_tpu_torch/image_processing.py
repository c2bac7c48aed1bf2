"""Image-domain helpers: mask dilation and resolution math.

Counterpart of ``hive_tpu/image_processing.py`` (``dilate_mask`` and
``calculate_target_resolution``). The JAX package dilates with OpenCV; the
port has no OpenCV, so a dilation by the all-ones rectangular element becomes
``max_pool2d`` passes (stride 1, -inf padding), which is what ``cv2.dilate``
computes with its default border.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

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

    if dilation_options.num_iterations > 0:
        # cv2 anchors a k x k element at k // 2: output(p) is the max over
        # p - k//2 .. p + (k - 1 - k//2) on each axis.
        k = int(dilation_options.filter_size)
        lo, hi = k // 2, k - 1 - k // 2
        x = x[None, None]
        for _ in range(dilation_options.num_iterations):
            x = F.max_pool2d(F.pad(x, (lo, hi, lo, hi), value=-float("inf")),
                             kernel_size=k, stride=1)
        x = x[0, 0]

    out = x != 0
    return out.cpu().numpy() if as_numpy else out


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
