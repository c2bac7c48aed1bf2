"""Image-quality metrics: SSIM, PSNR, LPIPS, MIFD, and depth errors.

Counterpart of ``hive_tpu/metrics.py``. ``psnr`` and the host ``ssim`` run
in float64 numpy; ``ssim``'s Gaussian window is the reference's
``cv2.filter2D(..., BORDER_REFLECT)`` as a separable numpy correlation over a
symmetric pad (OpenCV may take its DFT route for an 11x11 float64 kernel, so
the two agree to rounding, not to the bit). ``batch_ssim_psnr`` runs on the
card: a grouped ``conv2d`` after the same symmetric pad, float32, TF32 off.
``mifd`` matches the port's SIFT (``ops/sift.py``, OpenCV's detector) with
the exact k-NN (``ops/matching.py``) where the reference runs cv2's SIFT and
FLANN. ``lpips`` scores with ``models/lpips.py`` and
``$WEIGHTS_PATH/lpips_alex.npz``; without that file it gives NaN, labelled
"skipped: weights absent" by :func:`metric_skip_notes`. The reference's
last resort, the pip ``lpips`` package, is a package of finished models and
is not used here.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hive_tpu_torch import get_device


# ---------------------------------------------------------------------------
# PSNR / SSIM.
# ---------------------------------------------------------------------------

def psnr(image_a: np.ndarray, image_b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two images."""
    a = np.asarray(image_a, dtype=np.float64)
    b = np.asarray(image_b, dtype=np.float64)

    mse = np.mean((a - b) ** 2)

    if mse == 0:
        return float("inf")

    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    offsets = np.arange(size) - (size - 1) / 2.0
    kernel = np.exp(-(offsets ** 2) / (2 * sigma ** 2))
    return kernel / kernel.sum()


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    kernel_1d = _gaussian_kernel_1d(size, sigma)
    return np.outer(kernel_1d, kernel_1d)


def _filter2d_reflect(plane: np.ndarray, kernel_1d: np.ndarray) -> np.ndarray:
    """The separable correlation of a float64 (H, W) plane with
    ``outer(kernel_1d, kernel_1d)``, OpenCV's BORDER_REFLECT border
    (numpy's ``symmetric``)."""
    pad = len(kernel_1d) // 2
    height, width = plane.shape
    padded = np.pad(plane, pad, mode="symmetric")
    rows = sum(k * padded[:, j:j + width] for j, k in enumerate(kernel_1d))
    return sum(k * rows[i:i + height] for i, k in enumerate(kernel_1d))


def ssim(image_a: np.ndarray, image_b: np.ndarray, data_range: float = 255.0) -> float:
    """Structural similarity (Wang et al. 2004), 11x11 Gaussian window.

    Multi-channel images are averaged over channels (the scikit-image
    convention).
    """
    a = np.asarray(image_a, dtype=np.float64)
    b = np.asarray(image_b, dtype=np.float64)

    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]

    kernel_1d = _gaussian_kernel_1d()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def filter2d(img):
        return np.stack([_filter2d_reflect(img[..., ch], kernel_1d)
                         for ch in range(img.shape[-1])], axis=-1)

    mu_a = filter2d(a)
    mu_b = filter2d(b)

    mu_a2 = mu_a ** 2
    mu_b2 = mu_b ** 2
    mu_ab = mu_a * mu_b

    sigma_a2 = filter2d(a * a) - mu_a2
    sigma_b2 = filter2d(b * b) - mu_b2
    sigma_ab = filter2d(a * b) - mu_ab

    ssim_map = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) \
        / ((mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2))

    return float(ssim_map.mean())


def ssim_psnr(image_a: np.ndarray, image_b: np.ndarray, data_range: float = 255.0,
              device=None) -> Tuple[float, float]:
    """:func:`ssim` and :func:`psnr` of one pair, computed on ``device``
    (default ``cuda:0``) in float64 with the host functions' operations in
    their order: the same separable correlation over the same symmetric
    pad, so only the final means' summation order differs from the host's.
    For integer images the squared error is summed exactly in int64, which
    makes the PSNR the host's to the bit.

    :return: (SSIM, PSNR); PSNR is infinite for identical images.
    """
    device = get_device(device)
    a = torch.as_tensor(np.ascontiguousarray(image_a), device=device)
    b = torch.as_tensor(np.ascontiguousarray(image_b), device=device)
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]

    if a.is_floating_point() or b.is_floating_point():
        mse = float(torch.mean((a.double() - b.double()) ** 2))
    else:
        diff = a.long() - b.long()
        mse = int(torch.sum(diff * diff)) / diff.numel()
    psnr_value = float("inf") if mse == 0 else float(10.0 * np.log10(data_range ** 2 / mse))

    a, b = a.double(), b.double()
    height, width, channels = a.shape
    kernel_1d = _gaussian_kernel_1d().tolist()
    pad = len(kernel_1d) // 2
    rows_index = _symmetric_index(height, pad, device)
    cols_index = _symmetric_index(width, pad, device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    # The five filtered quantities of every channel as (5 * C, H, W) planes.
    planes = torch.stack([a, b, a * a, b * b, a * b]).permute(0, 3, 1, 2).reshape(
        5 * channels, height, width)
    padded = planes[:, rows_index][:, :, cols_index]
    rows = sum(k * padded[:, :, j:j + width] for j, k in enumerate(kernel_1d))
    filtered = sum(k * rows[:, i:i + height] for i, k in enumerate(kernel_1d))
    mu_a, mu_b, filt_aa, filt_bb, filt_ab = filtered.reshape(5, channels, height, width)

    mu_a2 = mu_a ** 2
    mu_b2 = mu_b ** 2
    mu_ab = mu_a * mu_b
    sigma_a2 = filt_aa - mu_a2
    sigma_b2 = filt_bb - mu_b2
    sigma_ab = filt_ab - mu_ab

    ssim_map = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) \
        / ((mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2))

    return float(ssim_map.mean()), psnr_value


def _symmetric_index(length: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's ``symmetric`` pad (edge included) along one axis."""
    inner = torch.arange(length, device=device)
    return torch.cat([inner[:pad].flip(0), inner, inner[length - pad:].flip(0)])


def batch_ssim_psnr(frames_a: np.ndarray, frames_b: np.ndarray, data_range: float = 255.0,
                    device=None):
    """Batched SSIM + PSNR on the card, float32: (N, H, W, C) pairs -> (N,),
    (N,) float32 numpy arrays.

    :param device: where it runs; default ``cuda:0``.
    """
    device = get_device(device)
    kernel = torch.as_tensor(_gaussian_kernel(), dtype=torch.float32, device=device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    pad = kernel.shape[0] // 2

    a = torch.as_tensor(np.asarray(frames_a), device=device).to(torch.float32).permute(0, 3, 1, 2)
    b = torch.as_tensor(np.asarray(frames_b), device=device).to(torch.float32).permute(0, 3, 1, 2)
    channels, height, width = a.shape[1:]

    mse = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    psnr_values = 10.0 * torch.log10(torch.full_like(mse, data_range ** 2)
                                     / torch.clamp(mse, min=1e-12))

    # Depthwise Gaussian over a symmetric (edge-inclusive) pad: OpenCV's
    # BORDER_REFLECT, which the host ssim uses.
    rows = _symmetric_index(height, pad, device)
    cols = _symmetric_index(width, pad, device)
    weight = kernel[None, None].expand(channels, 1, -1, -1)

    def blur(x):
        return F.conv2d(x[:, :, rows][:, :, :, cols], weight, groups=channels)

    mu_a, mu_b = blur(a), blur(b)
    sigma_a2 = blur(a * a) - mu_a ** 2
    sigma_b2 = blur(b * b) - mu_b ** 2
    sigma_ab = blur(a * b) - mu_a * mu_b

    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * sigma_ab + c2)) \
        / ((mu_a ** 2 + mu_b ** 2 + c1) * (sigma_a2 + sigma_b2 + c2))

    return (torch.mean(ssim_map, dim=(1, 2, 3)).cpu().numpy(), psnr_values.cpu().numpy())


# ---------------------------------------------------------------------------
# MIFD: mean SIFT-match pixel distance.
# ---------------------------------------------------------------------------

def mifd(image_a: np.ndarray, image_b: np.ndarray, ratio_threshold: float = 0.7,
         device=None) -> float:
    """Mean image feature distance: the average pixel distance between the
    matched SIFT features of two uint8 images (NaN when nothing matches).

    :param device: where SIFT and the matching run; default ``cuda:0``.
    """
    from hive_tpu_torch.ops import matching, sift

    device = get_device(device)

    def features(image):
        image = torch.as_tensor(np.ascontiguousarray(image), device=device)
        return sift.detect_and_compute(sift.rgb_to_grey(image) if image.dim() == 3 else image)

    features_a, features_b = features(image_a), features(image_b)
    if len(features_a) < 2 or len(features_b) < 2:
        return float("nan")

    indices, distances = matching.knn2(features_a.descriptors, features_b.descriptors)
    # The reference skips a match when m.distance > ratio * n.distance.
    keep = matching.ratio_test(distances, ratio_threshold, strict=False)
    if not bool(keep.any()):
        return float("nan")

    # The distances and their mean on the host: the card's norm and mean
    # reduce in other orders than the CPU's.
    pt_a = features_a.xy[keep].double().cpu()
    pt_b = features_b.xy[indices[keep, 0]].double().cpu()
    return float(torch.linalg.norm(pt_a - pt_b, dim=1).mean())


# ---------------------------------------------------------------------------
# LPIPS (weights-gated).
# ---------------------------------------------------------------------------

# The resolved scorers by device: False where the weights are unavailable.
_lpips_models = {}


def _resolve_lpips(device=None):
    """Resolve (once per device) the LPIPS scorer from
    ``$WEIGHTS_PATH/lpips_alex.npz`` on ``device`` (default ``cuda:0``),
    else False."""
    device = get_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    if device not in _lpips_models:
        from hive_tpu_torch.models.lpips import WEIGHTS_FILENAME, load_scorer

        scorer = load_scorer(device=device)
        if scorer is None:
            logging.warning(f"LPIPS unavailable (no usable $WEIGHTS_PATH/{WEIGHTS_FILENAME}); "
                            "reporting NaN.")
        _lpips_models[device] = scorer if scorer is not None else False

    return _lpips_models[device]


def lpips_available(device=None) -> bool:
    """True when :func:`lpips` can produce real numbers on ``device``
    (default ``cuda:0``): its weights resolved."""
    return _resolve_lpips(device) is not False


def metric_skip_notes(results: dict, device=None) -> dict:
    """Self-describing skip labels for metrics whose samples are ALL
    non-finite: results tables say WHY a column is empty.

    :param results: metric name -> list of per-sample values.
    :param device: where LPIPS was scored; default ``cuda:0``.
    :return: metric name -> reason string, only for fully-skipped metrics.
    """
    notes = {}
    for metric, values in results.items():
        values = [v for v in values if isinstance(v, (int, float, np.floating))]
        if values and not any(np.isfinite(values)):
            if metric == "lpips" and not lpips_available(device):
                notes[metric] = "skipped: weights absent"
            else:
                notes[metric] = "skipped: all values non-finite"
    return notes


def lpips(image_a: np.ndarray, image_b: np.ndarray, device=None) -> float:
    """Learned perceptual similarity (AlexNet LPIPS v0.1) with
    ``$WEIGHTS_PATH/lpips_alex.npz``; NaN with a warning without it.

    :param device: where the scorer runs; default ``cuda:0``.
    """
    scorer = _resolve_lpips(device)
    if scorer is False:
        return float("nan")

    return scorer(np.ascontiguousarray(image_a[..., :3]), np.ascontiguousarray(image_b[..., :3]))


# ---------------------------------------------------------------------------
# Depth error metrics.
# ---------------------------------------------------------------------------

def depth_mae(pred: np.ndarray, target: np.ndarray,
              valid_mask: Optional[np.ndarray] = None) -> float:
    if valid_mask is None:
        valid_mask = target > 0

    return float(np.abs(pred[valid_mask] - target[valid_mask]).mean())


def depth_rmse(pred: np.ndarray, target: np.ndarray,
               valid_mask: Optional[np.ndarray] = None) -> float:
    if valid_mask is None:
        valid_mask = target > 0

    return float(np.sqrt(np.mean((pred[valid_mask] - target[valid_mask]) ** 2)))
